"""Host-side engine pieces of the port: the prefix-cache radix tree and
its host tier, the bounded stage worker, and the prefix ledger."""
