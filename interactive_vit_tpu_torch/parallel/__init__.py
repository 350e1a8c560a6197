"""Training steps on one device and the qkv column layouts they use."""
