"""Host-side I/O: dataset loading, output writing, device prefetch."""
