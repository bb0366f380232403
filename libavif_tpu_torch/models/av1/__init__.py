"""AV1 entropy-coding models: the msac encoder and decoder."""
