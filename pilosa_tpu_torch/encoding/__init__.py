"""Wire encodings of the port's HTTP bodies (protobuf)."""
