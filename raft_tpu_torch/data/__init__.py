"""Data readers: the port's own PNG/PPM codec, flow files and the
evaluation datasets (no PIL, no cv2)."""
