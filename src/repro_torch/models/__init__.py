"""Model math of the port: the dense, moe, ssm and hybrid families of the reference."""
