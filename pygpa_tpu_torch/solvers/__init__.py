"""Per-pixel least squares and the multigrid phase unwrap."""
