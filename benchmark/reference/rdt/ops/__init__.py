"""Operators of the port (K5 expand, K2 DCN sampling, sparse conv, NMS)."""
