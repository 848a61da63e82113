"""OSD-side pieces of the data path: the cross-PG codec batcher."""
