"""Layer ops, the fused block kernel and its dispatch."""
