"""Launch-time drivers of the port: the multi-card placement sweep
(``placement_mesh``) and the language-model serving CLI (``serve``)."""
