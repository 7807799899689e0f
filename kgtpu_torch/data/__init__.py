"""Host-side data of the port (NumPy and zlib only, no cv2): PNG codec,
dataset readers, the eval-path resize and the batch contract."""
