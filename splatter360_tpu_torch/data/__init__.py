"""Scene storage, view samplers and the example stream (host-side numpy)."""
