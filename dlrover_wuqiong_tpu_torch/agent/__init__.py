"""Node-side client of the master (parity: dlrover_wuqiong_tpu/agent)."""
