"""Kernels and their plain versions (parity: dlrover_wuqiong_tpu/ops)."""
