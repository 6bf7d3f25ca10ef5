"""Serving: query plans, the Session entry point, the batched device server."""
