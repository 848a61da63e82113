"""Monitor-side placement: the bulk PG->OSD recompute (``pg_mapping``)."""
