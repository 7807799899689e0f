"""Host-side data helpers of the port (NumPy only, no cv2)."""
