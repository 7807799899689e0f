"""Host-side data of the port (NumPy, zlib and struct only, no cv2 or PIL):
the image readers (`imread.read_image`: PNG, JPEG, TIFF, BMP), the dataset
readers, the eval-path resize and the batch contract."""
