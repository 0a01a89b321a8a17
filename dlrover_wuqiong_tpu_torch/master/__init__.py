"""Job master: the serving queue and the RPC verbs it answers (parity:
dlrover_wuqiong_tpu/master)."""
