"""Index layer: dense (device matmul) + BM25 (CSR) indices and artifact I/O."""
