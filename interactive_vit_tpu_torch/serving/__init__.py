"""HTTP serving: app, micro-batcher, metrics, entry point."""
