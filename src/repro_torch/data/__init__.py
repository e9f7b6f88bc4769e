"""The train path's synthetic token pipeline (and the committed quick-fit
model file the estimators load)."""
