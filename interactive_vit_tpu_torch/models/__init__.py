"""Models and their graph-node plugins."""
