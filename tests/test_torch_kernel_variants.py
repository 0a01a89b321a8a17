"""The on-card A/B scripts' text substitutions against the committed sources.

``fa_fwd_variants.py``, ``fa_bwd_variants.py`` and ``int8_variants.py``
build variants of the port's CUDA sources by replacing exact pieces of
their text, and run only on a card.  A source edit that moves one of those
pieces would show only there, as a failed run.  These tests build every
variant's text here: each substitution must still apply (the scripts exit
when a piece is not found exactly once) and change the source.
"""

import difflib

import pytest

import fa_bwd_variants
import fa_fwd_variants
import int8_variants

SCRIPTS = {"fa_fwd_variants": fa_fwd_variants,
           "fa_bwd_variants": fa_bwd_variants,
           "int8_variants": int8_variants}


def _variants(script):
    with open(script.SRC) as f:
        src = f.read()
    return src, script.variants(src)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_every_variant_applies_and_differs(name):
    src, out = _variants(SCRIPTS[name])
    assert len(out) >= 2
    # one build is the source as committed (int8's is the loads variant
    # that matches the committed load count)
    assert sum(text == src for text in out.values()) == 1


@pytest.mark.parametrize("variant,lines", [("dkv_stages2", 1),
                                           ("dkv_bq64", 1),
                                           ("dkv_exp2f", 1),
                                           ("dkv_per_item", 2)])
def test_dkv_variants_touch_only_the_dkv_kernel(variant, lines):
    """Each dk/dv variant replaces its few lines of the dk/dv kernel (the
    item loop and the grid for one block per item) and leaves the fused
    backward's launch bounds and role dispatch (which the fused variants
    substitute) as they are."""
    src, out = _variants(fa_bwd_variants)
    text = out[variant]
    assert len(fa_bwd_variants.BOUNDS.findall(text)) == 1
    assert text.count(fa_bwd_variants.DISPATCH) == 1
    removed = [ln for ln in difflib.ndiff(src.splitlines(),
                                          text.splitlines())
               if ln.startswith("- ")]
    assert len(removed) == lines, removed


def test_dkv_timed_variant_only_fills_the_clock_hooks():
    """The timed build is the committed source with the empty clock hooks
    defined and a reader of the clock sums appended."""
    src, out = _variants(fa_bwd_variants)
    text = out["dkv_timed"]
    assert text.endswith(fa_bwd_variants.CLOCK_READ)
    text = text[:-len(fa_bwd_variants.CLOCK_READ)]
    assert text.replace(fa_bwd_variants.TIMED_HOOKS,
                        fa_bwd_variants.DKV_HOOKS) == src


# the pieces the fused and dk/dv builds substitute, which a dq build must
# leave as they are
_FUSED_AND_DKV = ("DISPATCH", "DKV_STAGES", "DKV_BQ", "DKV_ITEMS",
                  "DKV_GRID", "DKV_HOOKS", "DKV_EXP")


@pytest.mark.parametrize("variant,lines", [("dq_stages2", 1),
                                           ("dq_stages3", 1),
                                           ("dq_bk64", 1),
                                           ("dq_pairs", 4),
                                           ("dq_early_items", 1),
                                           ("dq_exp2f", 1),
                                           ("dq_per_item", 2),
                                           ("dq_qs_smem", 2),
                                           ("dq_do_smem", 2)])
def test_dq_variants_touch_only_the_dq_kernel(variant, lines):
    """Each dq variant replaces its few lines of the dq kernel (the ring
    depth, the kv tile and the loop and registers of a two-tile step, the
    order of the producer's loads, the exponential, the item loop and the
    grid for one block per item, where Q_s or dO come from) and leaves the
    fused
    backward's and the dk/dv kernel's substituted pieces as they are."""
    src, out = _variants(fa_bwd_variants)
    text = out[variant]
    assert len(fa_bwd_variants.BOUNDS.findall(text)) == 1
    for piece in _FUSED_AND_DKV:
        assert text.count(getattr(fa_bwd_variants, piece)) == 1, piece
    removed = [ln for ln in difflib.ndiff(src.splitlines(),
                                          text.splitlines())
               if ln.startswith("- ")]
    assert len(removed) == lines, removed


def test_dq_timed_variant_only_fills_the_clock_hooks():
    """The dq timed build is the committed source with the dq kernel's
    empty clock hooks defined and a reader of its clock sums appended."""
    src, out = _variants(fa_bwd_variants)
    text = out["dq_timed"]
    assert text.endswith(fa_bwd_variants.DQ_CLOCK_READ)
    text = text[:-len(fa_bwd_variants.DQ_CLOCK_READ)]
    assert text.replace(fa_bwd_variants.DQ_TIMED_HOOKS,
                        fa_bwd_variants.DQ_HOOKS) == src
