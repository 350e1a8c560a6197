"""Command-line tools: the trainer and its evaluation helper."""
