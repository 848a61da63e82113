"""Manager-plane passes over the OSDMap: the upmap balancer
(``balancer``), which reads the epoch placement table."""
