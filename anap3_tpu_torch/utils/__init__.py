"""Host-side I/O of the port: VTS export and the stored truths."""
