"""Launch (``repro.launch``): the serve and train CLIs, the sharding rules
(``sharding``) and the device meshes with the spec trees of the port's
state (``mesh``).  The XLA analysis tools (``dryrun``, ``hlo_analyze``,
``roofline``) are ROADMAP queue 1, item 11."""
