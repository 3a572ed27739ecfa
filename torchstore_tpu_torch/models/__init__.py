"""Model side of the port: the Llama family and its KV-cached decoder."""
