"""Host side of the port: the host-extract packer and the `audt` pipeline."""
