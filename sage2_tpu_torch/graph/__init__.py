"""Graph engine: transitive reduction (host native or device), unitig
labeling (device), cleaning and contig traversal (host)."""
