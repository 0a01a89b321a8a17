"""One-call acceleration (parity: dlrover_wuqiong_tpu/auto)."""
