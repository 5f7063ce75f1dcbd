"""Networks (NCHW ``nn.Module``s) and the TartanVO front-end."""
