"""Host side of the port: the window packer and the `audt`, `scan` and
`disc` pipelines."""
