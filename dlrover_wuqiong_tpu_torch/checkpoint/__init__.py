"""Flash checkpoint of torch training state (parity:
dlrover_wuqiong_tpu/checkpoint)."""
