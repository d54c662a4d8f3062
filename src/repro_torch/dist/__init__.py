"""Distribution plumbing: logical-axis sharding rules and mesh registry."""
