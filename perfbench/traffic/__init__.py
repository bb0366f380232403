"""Traffic generators; a mix is a data file beside them that names its generator."""
