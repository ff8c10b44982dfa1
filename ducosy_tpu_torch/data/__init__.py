"""Training data: patient pairing, the slice-pair dataset (with the port's
resize) and the threaded host loader."""
