"""Decode-side ops: cv2 Gaussian blur, heatmap/SimDR decode, coordinate unwarp."""
