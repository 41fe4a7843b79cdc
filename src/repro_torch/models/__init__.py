"""Model assembly: config, RWKV6 block, the model and its serve steps."""
