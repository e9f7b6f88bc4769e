"""The optimizer of the train path: AdamW with optional int8 moments, and
int8 gradient compression with error feedback."""
