"""Monitor-side placement: the cluster map (``osdmap.OSDMap``) and its epoch
placement table (``pg_mapping.PGMapping`` over the bulk recompute
``bulk_crush_rows``).  A map is carried across from another implementation
by its ``to_dict()`` and ``OSDMap.from_dict(d, device=...)``."""
