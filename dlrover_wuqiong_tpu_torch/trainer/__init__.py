"""Training (parity: dlrover_wuqiong_tpu/trainer)."""
