"""Field and statistics operations on torch tensors (see the package doc)."""
