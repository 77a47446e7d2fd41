"""Models of the port: the DLRM."""
