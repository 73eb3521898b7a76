"""The readers of the benchmark's metrics, one file each (see
``spec.reader``)."""
