"""The benchmark's own code: what every cell shares (loading the cell's
files by name, the generator, the driver's window, the trace's reading, the
comparison that decides ``correct``)."""
