"""Per-architecture configs.  The port carries only the paper's HSTU-GR."""
