"""Dense transformer math for serving (the dense family of the reference)."""
