"""Graph engine: transitive reduction (host native), unitig labeling
(device), cleaning and contig traversal (host)."""
