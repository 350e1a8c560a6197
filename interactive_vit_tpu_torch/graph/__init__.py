"""Graph IR, node-kind registry and executor."""
