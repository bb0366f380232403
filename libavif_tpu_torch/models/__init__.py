"""Host-side models: the AV1 multi-symbol arithmetic coder (msac)."""
