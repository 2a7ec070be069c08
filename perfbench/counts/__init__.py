"""The yardstick's arithmetic: the H100's published peaks, the operations
and bytes of each hand-written kernel's launch, and the model's
operations per unit of work, all counted from shapes."""
