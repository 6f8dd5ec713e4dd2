"""Launch-time drivers of the port: the multi-card placement sweep
(``placement_mesh``)."""
