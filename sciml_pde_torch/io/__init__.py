"""HDF5 seed-group files (the schema the JAX package writes), and the
port's own subset of HDF5 for hosts without h5py."""
