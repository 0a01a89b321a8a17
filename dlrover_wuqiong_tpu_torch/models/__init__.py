"""Model configurations and parameters (parity: dlrover_wuqiong_tpu/models)."""
