"""Serving ledger, trace spans and the flight recorder (parity:
dlrover_wuqiong_tpu/telemetry)."""
