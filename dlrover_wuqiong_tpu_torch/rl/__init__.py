"""Generation over a KV cache (parity: dlrover_wuqiong_tpu/rl)."""
