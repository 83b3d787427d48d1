"""Tools of the port for reading its kernels on a machine with nvcc."""
