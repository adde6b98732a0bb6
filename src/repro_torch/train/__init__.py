"""Serving steps of the port (``repro.train``'s ``serve_step``)."""
