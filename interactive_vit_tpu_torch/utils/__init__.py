"""Weight files: the safetensors reader and writer, the checkpoint
directory."""
