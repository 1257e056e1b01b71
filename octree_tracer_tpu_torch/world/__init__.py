"""World: chunk store, mip trees, chunk streaming."""
