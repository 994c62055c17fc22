"""Model zoo of the port: the dense decoder and the qwen2_100m LGC task."""
