"""Per-architecture configs: a copy of each of the reference's, one module per id."""
