"""flink_tpu_torch.lint"""
