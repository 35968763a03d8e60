"""Plain tensor ops: box coding, rotated IoU, NMS."""
