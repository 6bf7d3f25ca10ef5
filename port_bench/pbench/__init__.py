"""The benchmark's own library: collection, traffic, reference, work counts,
trace reading and the cell runner.  Nothing here imports the program, except
``runner``, which drives it."""
