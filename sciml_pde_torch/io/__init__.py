"""HDF5 seed-group reads (the schema the JAX package writes)."""
