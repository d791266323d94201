"""Search layer: engine, service, scoring, tokenization."""
