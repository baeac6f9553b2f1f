"""Parallel and collective pieces of the port: the absmax quantizer that
the int8 weights and KV pools share (``comm_compress``)."""
