"""Flag-compatible command-line entry points (reference CLI surface).

python -m multi_style_transfer_gan.cli.<tool>:
  direct_transform        (direct_transform.py)
  batch_process_images    (batch_process_images.py)
  advanced_transform      (advanced_transform.py)
  enhanced_local_style    (enhanced_local_style.py)
  compare_image_quality   (compare_image_quality.py)
  complete_comparison     (complete_comparison.py)
  convert_model           (convert_model.py)
  pth_info                (pth_info.py)
  pretrain / train        (pretrain.py / enhanced_train.py)
  m_test                  (m_test.py)
"""
