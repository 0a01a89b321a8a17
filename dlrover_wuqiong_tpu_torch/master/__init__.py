"""Job master: the training, sharding and serving managers, the journal
and the RPC verbs (parity: dlrover_wuqiong_tpu/master)."""
