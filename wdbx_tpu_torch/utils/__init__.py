"""Cross-cutting utilities: config file loading, locks, metrics."""
