"""Device meshes and parameter sharding over ``torch.distributed``
(`mesh`, `sharding`)."""
