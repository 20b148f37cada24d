"""The benchmark's yardstick: the card's peaks, and the operations and bytes
that a cell's inputs need, counted from the configuration and the shapes.
It imports nothing of the port."""
