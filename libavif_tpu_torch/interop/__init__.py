"""Interop oracles: bindings to battle-tested external AVIF/AV1
implementations installed in the image, used for conformance validation
and honest CPU baselines — never on the product data path."""
