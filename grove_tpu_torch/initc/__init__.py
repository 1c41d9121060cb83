"""The startup gate's in-process agent path (grove_tpu/initc counterpart)."""
