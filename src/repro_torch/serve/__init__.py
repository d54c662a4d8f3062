"""Serving: the paged decode runner and the continuous-batching engine."""
