"""Host-side helpers: images, timings, the YAML subset reader."""
