"""Model configs: the reference's schema and the ten LM configs, copied."""
