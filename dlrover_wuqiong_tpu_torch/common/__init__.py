"""Records shared across layers (parity: dlrover_wuqiong_tpu/common)."""
