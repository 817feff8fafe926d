"""Host-side utilities: the MessagePack codec of ``.tdn`` bundles, the
anchor config reader, mAP evaluation and drawing."""
