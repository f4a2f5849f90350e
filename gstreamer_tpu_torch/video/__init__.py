"""Host planning and device functions of the video library (torch port)."""
