"""Stage IR and the CUDA lowering."""
