"""Serving: the v2 ragged engine (``inference.v2``)."""
