"""Multi-device and multi-process runs of the port: the shard mesh, the
`torch.distributed` bootstrap and the sharded audit, consensus and disc
steps (`parallel.mesh`)."""
