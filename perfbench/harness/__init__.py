"""The benchmark's harness: the cell's files found by name, the traffic
generator, the data and weights made from the seed, the trace reduction,
the table of peaks and the comparison that decides `correct`.  It imports
the program under test only inside the system adapters (perfbench/systems/)."""
