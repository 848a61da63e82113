"""The data plane's launch engine: MeshCodec, a one-card stripe plane."""
