"""Serving: the continuous-batching engine and its KV bookkeeping."""
