"""Port parity: the checkpoint storage backends and their registry.

The port's `common/storage.py` against the JAX package's:

- an object-store path (``gs://``, ``s3://``, ``az://``) resolves to
  the port's `ObjectStoreStorage`, a POSIX path to `PosixDiskStorage`;
  a storage meta that JAX wrote naming ``ObjectStoreStorage`` resolves
  to the port's object store, and an unknown class name to the POSIX
  store, as JAX's lookup does;
- `ObjectStoreStorage` on a POSIX path (``etils.epath`` routes it
  there) leaves files byte-equal to JAX's for the same writes, text,
  bytes and a streamed file object, with the same listings, reads and
  removals (tests/test_checkpoint.py::TestObjectStoreStorage);
- a GPT nano flash checkpoint saved through the saver with an
  ``ObjectStoreStorage`` meta commits, and its restore resumes bitwise.

No bucket is reached (no network): ``gs://`` itself is tested nowhere.
Without ``etils`` the object-store tests skip; the chip host has none.
"""

import io
import os

import numpy as np
import pytest
import torch

from dlrover_wuqiong_tpu.common import storage as jstorage
from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
    AsyncCheckpointSaver,
    read_last_step,
)
from dlrover_wuqiong_tpu_torch.common import storage as tstorage
from dlrover_wuqiong_tpu_torch.telemetry.ledger import reset_ledger
from torch_threads import one_torch_thread  # noqa: F401

pytest.importorskip("etils.epath")


@pytest.fixture(autouse=True)
def _fresh_saver():
    AsyncCheckpointSaver.reset()
    reset_ledger()
    yield
    AsyncCheckpointSaver.reset()
    reset_ledger()


@pytest.mark.parametrize("hint,cls", [
    ("/tmp/x", "PosixDiskStorage"), ("relative/dir", "PosixDiskStorage"),
    ("gs://bucket/ckpt", "ObjectStoreStorage"),
    ("s3://bucket/ckpt", "ObjectStoreStorage"),
    ("az://container/ckpt", "ObjectStoreStorage")])
def test_scheme_resolution_is_jax(hint, cls):
    got = tstorage.get_checkpoint_storage(path_hint=hint)
    want = jstorage.get_checkpoint_storage(path_hint=hint)
    assert type(got).__name__ == type(want).__name__ == cls
    assert type(got).__module__.startswith("dlrover_wuqiong_tpu_torch.")


def test_jax_meta_resolves_to_the_ports_object_store():
    """A meta written by JAX's object store (``get_class_meta``) names a
    class the port registers; the port builds its own, not a POSIX store
    under that name.  An unknown name falls back as JAX's lookup does."""
    meta = jstorage.ObjectStoreStorage().get_class_meta()
    got = tstorage.get_checkpoint_storage(meta)
    assert isinstance(got, tstorage.ObjectStoreStorage)
    assert got.get_class_meta() == meta
    assert set(tstorage._STORAGE_REGISTRY) == set(jstorage._STORAGE_REGISTRY)
    odd = {"class_name": "NoSuchStorage", "kwargs": {}}
    assert type(tstorage.get_checkpoint_storage(odd)).__name__ == \
        type(jstorage.get_checkpoint_storage(odd)).__name__ == \
        "PosixDiskStorage"


def _drive(storage, root):
    """The same writes, reads and removals through `storage` under
    `root`; returns what the reads saw."""
    seen = {}
    storage.safe_makedirs(os.path.join(root, "a", "b"))
    storage.write("step 7\n", os.path.join(root, "tracker.txt"))
    payload = bytes(range(256)) * 33
    storage.write(payload, os.path.join(root, "a", "shard.bin"))
    storage.write(memoryview(payload[:100]), os.path.join(root, "a",
                                                          "view.bin"))
    storage.write_fileobj(io.BytesIO(payload * 5),
                          os.path.join(root, "a", "b", "stream.bin"),
                          len(payload) * 5 - 3)
    storage.write("gone", os.path.join(root, "a", "b", "tmp.txt"))
    seen["text"] = storage.read(os.path.join(root, "tracker.txt"), "r")
    seen["bytes"] = storage.read(os.path.join(root, "a", "shard.bin"))
    seen["missing"] = storage.read(os.path.join(root, "nope.bin"))
    seen["list_a"] = storage.listdir(os.path.join(root, "a"))
    seen["list_missing"] = storage.listdir(os.path.join(root, "nope"))
    storage.safe_remove(os.path.join(root, "a", "b", "tmp.txt"))
    storage.safe_remove(os.path.join(root, "nope.bin"))
    seen["exists_removed"] = storage.exists(
        os.path.join(root, "a", "b", "tmp.txt"))
    seen["exists"] = storage.exists(os.path.join(root, "a", "shard.bin"))
    storage.commit(7, True)
    return seen


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_object_store_files_equal_jax(tmp_path):
    """The port's and JAX's `ObjectStoreStorage` on POSIX paths: the same
    files with the same bytes (no tmp file left behind), the same reads,
    listings and removals."""
    got = _drive(tstorage.ObjectStoreStorage(), str(tmp_path / "port"))
    want = _drive(jstorage.ObjectStoreStorage(), str(tmp_path / "jax"))
    assert got == want
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert sorted(_tree(tmp_path / "port")) == [
        "a/b/stream.bin", "a/shard.bin", "a/view.bin", "tracker.txt"]


def test_flash_checkpoint_through_object_store_resumes_bitwise(tmp_path):
    """GPT nano's `TrainState` through `CheckpointEngine`'s saver with the
    storage an ``ObjectStoreStorage`` meta names, on a POSIX path: the
    step commits (the tracker through the object store), and a fresh
    model restored from it takes the next step bitwise as the original
    does."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.checkpoint.engine import (
        CheckpointEngine,
        restore_tree,
    )
    from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
    from dlrover_wuqiong_tpu_torch.trainer.train_step import (
        TrainState,
        adamw,
        make_lm_loss,
        make_train_step,
    )

    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                              remat=False)
    step = make_train_step(make_lm_loss())
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        x = torch.from_numpy(rng.integers(0, 512, (2, 33)))
        batches.append({"input_ids": x[:, :-1], "labels": x[:, 1:]})

    def build(seed):
        model = tgpt.GPT(cfg)
        model.init_params(seed, "cpu")
        return TrainState.create(model, adamw(3e-4))

    state = build(0)
    state, _ = step(state, batches[0])
    storage = tstorage.get_checkpoint_storage(
        {"class_name": "ObjectStoreStorage", "kwargs": {}})
    ckdir = str(tmp_path / "obj")
    eng = CheckpointEngine(ckdir, job_name=f"tso{os.getpid()}",
                           standalone=True, storage=storage)
    try:
        eng.save_to_storage(1, state.tree())
        assert eng.wait_saving_latest(60)
        assert read_last_step(ckdir, storage) == 1
        fresh = build(1)
        flat = eng.load_from_storage()
        restore_tree(fresh.tree(), flat)
    finally:
        eng.close()
    assert int(fresh.step) == 1
    for b in batches[1:]:
        state, m = step(state, b)
        fresh, mf = step(fresh, b)
        assert m["loss"].item() == mf["loss"].item()
    for (n, p), q in zip(state.params.named_parameters(),
                         fresh.params.parameters()):
        assert torch.equal(p, q), n
