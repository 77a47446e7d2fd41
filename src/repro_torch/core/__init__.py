"""SDM core of the port: quantized rows, the HBM row cache, IO accounting."""
