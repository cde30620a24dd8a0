"""Data: the VOC / COCO datasets and the host augmentation chain of the WSSS
trainers (numpy), the threaded loader and device prefetch, the on-device
augmentation (the classification chain), and DRFL's paired medical dataset."""
