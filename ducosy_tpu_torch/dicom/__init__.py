from ducosy_tpu_torch.dicom.codec import Dataset, dcmread, dcmwrite  # noqa: F401
