"""Serving ledger and trace spans (parity: dlrover_wuqiong_tpu/telemetry)."""
