"""Host-side data: numpy image preprocessing, shape buckets, the batch
loader and the device prefetcher."""
