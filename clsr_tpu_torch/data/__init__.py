"""Host data for serving: vocabularies, time features, the batch."""
